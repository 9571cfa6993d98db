"""The recursion benchmark's inner circuit: 2^(size - 1) + 1 noop gates,
built to degree 2^size, proved and verified (reference
plonky2/examples/bench_recursion.rs:202-230; the reference package's
examples/bench_recursion.py:22-37).

The recursion layers (`recursive_proof`) need the in-circuit verifier,
which the port does not have yet (ROADMAP); the middle circuit is read
from `bench_cache/middle14.circuit.bin` until then.

    python -m plonky2_torch.examples.bench_recursion --size 14   # on the card
"""

from __future__ import annotations

import argparse
import time

from plonky2_torch.gates.simple_gates import NoopGate
from plonky2_torch.iop.witness import PartialWitness
from plonky2_torch.plonk.circuit_builder import CircuitBuilder
from plonky2_torch.plonk.config import CircuitConfig


def _num_dummy_gates(log2_size: int) -> int:
    if log2_size < 1:
        raise ValueError("log2_size must be at least 1")
    return 0 if log2_size == 1 else (1 if log2_size == 2 else (1 << (log2_size - 1)) + 1)


def dummy_circuit(config: CircuitConfig, log2_size: int, device=None, timing=None):
    """The built inner circuit (CircuitData), committed on `device`."""
    builder = CircuitBuilder(config)
    for _ in range(_num_dummy_gates(log2_size)):
        builder.add_gate(NoopGate(), [])
    return builder.build(device=device, timing=timing)


def dummy_proof(config: CircuitConfig, log2_size: int, device=None):
    """(proof, verifier-only data, common data) of the inner circuit, built
    and proved on `device` (CUDA unless the caller asks for another) and
    verified."""
    data = dummy_circuit(config, log2_size, device)
    proof = data.prove(PartialWitness(), device=device)
    data.verify(proof)
    return proof, data.verifier_only, data.common


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=14, help="log2 of the inner degree")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    proof, _, common = dummy_proof(CircuitConfig.standard_recursion_config(), args.size,
                                   args.device)
    print(f"inner proof (2^{common.degree_bits}): built, proved and verified in "
          f"{time.perf_counter() - t0:.2f} s")


if __name__ == "__main__":
    main()
