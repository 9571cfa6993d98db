"""Write the port's committed factorial data from the reference package.

    JAX_PLATFORMS=cpu python tests/torch_make_data.py

Builds the factorial circuit (100!, standard recursion config) with the
reference under the pinned seed 2026, as `fixtures/factorial.proof.bin`
was made, and writes
  plonky2_torch/data/factorial.prover.bin   the reference's prover_data_to_bytes
  plonky2_torch/data/factorial.witness.npz  witness [num_wires, degree] u64,
                                            public inputs, public-inputs hash
so that the port proves factorial without the reference. Not collected by
pytest; `tests/test_torch_plonk.py` holds both files equal to what this
makes.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "plonky2_torch", "data")
SEED = 2026  # tools/generate_fixtures.py


def factorial_data():
    """(prover bytes, witness, public inputs, public-inputs hash) of the
    factorial circuit, made by the reference under the pinned seed."""
    from plonky2_tpu.iop.witness import PartialWitness
    from plonky2_tpu.plonk.circuit_builder import CircuitBuilder
    from plonky2_tpu.plonk.config import CircuitConfig
    from plonky2_tpu.plonk.prover import prepare_witness
    from plonky2_tpu.plonk.prover_serialization import prover_data_to_bytes
    from plonky2_tpu.util import rng

    rng.seed(SEED)
    try:  # plonky2_tpu/examples/factorial.py's circuit and witness
        builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
        initial = builder.add_virtual_target()
        cur = initial
        for i in range(2, 101):
            cur = builder.mul(cur, builder.constant(i))
        builder.register_public_input(initial)
        builder.register_public_input(cur)
        data = builder.build()
        pw = PartialWitness()
        pw.set_target(initial, 1)
        witness, public_inputs, pi_hash = prepare_witness(data.prover_only, data.common, pw)
    finally:
        rng.seed(None)
    return (prover_data_to_bytes(data.prover_only, data.common), data,
            np.asarray(witness, dtype=np.uint64), list(public_inputs), list(pi_hash))


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, ROOT)
    import conftest  # noqa: F401  (JAX on the CPU, x64)

    prover_bytes, _, witness, public_inputs, pi_hash = factorial_data()
    os.makedirs(DATA, exist_ok=True)
    with open(os.path.join(DATA, "factorial.prover.bin"), "wb") as f:
        f.write(prover_bytes)
    np.savez(os.path.join(DATA, "factorial.witness.npz"), witness=witness,
             public_inputs=np.asarray(public_inputs, dtype=np.uint64),
             public_inputs_hash=np.asarray(pi_hash, dtype=np.uint64))
    print(f"wrote {DATA}: prover data {len(prover_bytes)} bytes, witness {witness.shape}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
