"""Prove knowledge of a square root through a custom witness generator
(reference plonky2/examples/square_root.rs; the reference package's
examples/square_root.py).

`SquareRootGenerator` computes x from the input x², and the ArithmeticGate
that squares x computes x² from x: the circuit's level schedule has a cycle
that only the input breaks, so its generators run on the worklist scheduler
(the reference's dynamic one, `iop/generator.py`), `run_once` each, as in
the reference package. Its prover data is written with a registry that
holds it (`registry()`, for `prover_data_to_bytes` and `read_prover_data`).

    python -m plonky2_torch.examples.square_root          # on the card
"""

from __future__ import annotations

from plonky2_torch.field import scalar as fs
from plonky2_torch.iop.generator import SimpleGenerator
from plonky2_torch.iop.witness import PartialWitness
from plonky2_torch.plonk.circuit_builder import CircuitBuilder
from plonky2_torch.plonk.config import CircuitConfig


class SquareRootGenerator(SimpleGenerator):
    """x = sqrt(x_squared), computed outside the circuit."""

    def __init__(self, x, x_squared):
        self.x = x
        self.x_squared = x_squared

    def dependencies(self):
        return [self.x_squared]

    def outputs(self):
        return [self.x]

    def run_once(self, witness, out):
        x = fs.sqrt(witness.get_target(self.x_squared))
        if x is None:
            raise ValueError("the public input is not a quadratic residue")
        out.set_target(self.x, x)

    def serialize(self, w) -> None:
        """Its payload in a caller's serializer registry (reference
        square_root.rs `serialize`): the two targets."""
        w.write_target(self.x)
        w.write_target(self.x_squared)

    @classmethod
    def deserialize(cls, r) -> "SquareRootGenerator":
        return cls(r.target(), r.target())


def registry() -> list:
    """The default generator registry with SquareRootGenerator appended."""
    from plonky2_torch.plonk.prover_serialization import default_registry

    return default_registry() + [SquareRootGenerator]


def build_and_prove(x_value: int = 8846502094546981540, device=None):
    """Build, then prove, on `device` (CUDA unless the caller asks for
    another). Returns (CircuitData, ProofWithPublicInputs, x)."""
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
    x = builder.add_virtual_target()
    x_squared = builder.square(x)
    builder.register_public_input(x_squared)
    builder.add_simple_generator(SquareRootGenerator(x, x_squared))

    pw = PartialWitness()
    pw.set_target(x_squared, fs.mul(x_value, x_value))
    data = builder.build(device=device)
    return data, data.prove(pw, device=device), x_value


def main(device=None):
    data, proof, _ = build_and_prove(device=device)
    print(f"Proved knowledge of sqrt({proof.public_inputs[0]})")
    data.verify(proof)
    print("verified")


if __name__ == "__main__":
    main()
