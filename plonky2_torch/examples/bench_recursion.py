"""The recursion benchmark: an inner circuit of 2^(size - 1) + 1 noop gates,
built to degree 2^size, then two recursion layers, each a circuit that
verifies the proof of the layer below (reference
plonky2/examples/bench_recursion.rs:202-349; the reference package's
examples/bench_recursion.py:22-153). `lookup_type` picks the inner circuit
as the reference's `--lookup_type` does (bench_recursion.rs:70-74): 0 the
noop gates alone, 1 one lookup into the TIP5 table (its input public), 2
515 lookups on the TIP5 table; the lookups' gates come first, then the
noops up to the same row count.

    python -m plonky2_torch.examples.bench_recursion --size 14 [--lookup-type 1]

builds and proves (on the card) the inner circuit, the middle circuit over
it and the outer circuit over the middle one, verifies the three proofs,
and prints each layer's build and prove times.
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

from plonky2_torch import resolve_device
from plonky2_torch.gadgets.lookup import TIP5_TABLE
from plonky2_torch.gates.simple_gates import NoopGate
from plonky2_torch.iop.witness import PartialWitness
from plonky2_torch.plonk.circuit_builder import CircuitBuilder
from plonky2_torch.plonk.config import CircuitConfig
from plonky2_torch.recursion.recursive_verifier import (
    add_virtual_proof_with_pis,
    add_virtual_verifier_data,
    set_proof_with_pis_target,
    set_verifier_data_target,
    verify_proof,
)
from plonky2_torch.util import TimingTree


def _num_dummy_gates(log2_size: int) -> int:
    if log2_size < 1:
        raise ValueError("log2_size must be at least 1")
    return 0 if log2_size == 1 else (1 if log2_size == 2 else (1 << (log2_size - 1)) + 1)


LOOKUP_INPUT = 2  # the lookup inner circuits' input (bench_recursion.rs:144, :195)


def dummy_circuit(config: CircuitConfig, log2_size: int, device=None, timing=None):
    """The built inner circuit (CircuitData), committed on `device`."""
    builder = CircuitBuilder(config)
    for _ in range(_num_dummy_gates(log2_size)):
        builder.add_gate(NoopGate(), [])
    return builder.build(device=device, timing=timing)


def lookup_circuit(config: CircuitConfig, log2_size: int, lookup_type: int, device=None,
                   timing=None):
    """(CircuitData, inputs) of the inner circuit of `lookup_type` (1: the
    reference's dummy_lookup_proof, bench_recursion.rs:107-149; 2: its
    dummy_many_rows_proof, :151-200), committed on `device`; `inputs` sets
    the lookup input to LOOKUP_INPUT."""
    builder = CircuitBuilder(config)
    tip5 = builder.add_lookup_table_from_table(list(range(256)), TIP5_TABLE)
    initial_a = builder.add_virtual_target()
    if lookup_type == 1:
        builder.add_lookup_from_index(initial_a, tip5)
        builder.register_public_input(initial_a)
    elif lookup_type == 2:
        output = builder.add_lookup_from_index(initial_a, tip5)
        for _ in range(514):
            builder.add_lookup_from_index(output, tip5)
    else:
        raise ValueError(f"lookup_type {lookup_type} is not 1 or 2")
    target = _num_dummy_gates(log2_size)
    if target < builder.num_gates():
        raise ValueError("size too small to support lookups")
    for _ in range(builder.num_gates(), target):
        builder.add_gate(NoopGate(), [])
    pw = PartialWitness()
    pw.set_target(initial_a, LOOKUP_INPUT)
    return builder.build(device=device, timing=timing), pw


class Layer(NamedTuple):
    """A proof of one layer of the chain, its circuit and the seconds its
    build and its prove took."""
    proof: object
    data: object
    build_s: float
    prove_s: float

    @property
    def inner(self) -> tuple:
        """(proof, verifier-only data, common data): what the next layer
        verifies."""
        return self.proof, self.data.verifier_only, self.data.common


def _prove_layer(data, build_s: float, pw: PartialWitness, device) -> Layer:
    """`data` proved from `pw` on `device` and verified."""
    t = time.perf_counter()
    proof = data.prove(pw, device=device)
    prove_s = time.perf_counter() - t
    data.verify(proof)
    return Layer(proof, data, build_s, prove_s)


def dummy_proof(config: CircuitConfig, log2_size: int, device=None) -> Layer:
    """The inner circuit, built and proved on `device` (CUDA unless the
    caller asks for another) and verified."""
    device = resolve_device(device)
    t = time.perf_counter()
    data = dummy_circuit(config, log2_size, device)
    return _prove_layer(data, time.perf_counter() - t, PartialWitness(), device)


def dummy_lookup_proof(config: CircuitConfig, log2_size: int, device=None,
                       lookup_type: int = 1) -> Layer:
    """The lookup inner circuit of `lookup_type` (1: one TIP5 lookup, 2:
    515), built and proved on `device` (CUDA unless the caller asks for
    another) and verified."""
    device = resolve_device(device)
    t = time.perf_counter()
    data, pw = lookup_circuit(config, log2_size, lookup_type, device)
    return _prove_layer(data, time.perf_counter() - t, pw, device)


def dummy_many_rows_proof(config: CircuitConfig, log2_size: int, device=None) -> Layer:
    """The inner circuit with 515 lookups on the TIP5 table."""
    return dummy_lookup_proof(config, log2_size, device, lookup_type=2)


def recursion_circuit(inner_common, config: CircuitConfig, min_degree_bits=None,
                      device=None, timing: TimingTree | None = None):
    """(CircuitData, proof targets, verifier-data targets) of a circuit that
    verifies a proof of `inner_common`'s circuit and exposes its public
    inputs, padded with noops to at least 2^min_degree_bits rows where
    given. `timing` gets the scope "in-circuit verifier" and the build's."""
    timing = timing or TimingTree("build")
    builder = CircuitBuilder(config)
    with timing.scope("in-circuit verifier"):
        pt = add_virtual_proof_with_pis(builder, inner_common)
        vdt = add_virtual_verifier_data(builder, inner_common.config.fri_config.cap_height)
        verify_proof(builder, pt, vdt, inner_common)
        builder.register_public_inputs(pt.public_inputs)
        if min_degree_bits is not None:
            while builder.num_gates() < (1 << (min_degree_bits - 1)) + 1:
                builder.add_gate(NoopGate(), [])
    return builder.build(device=device, timing=timing), pt, vdt


def recursion_inputs(pt, vdt, inner) -> PartialWitness:
    """The inner proof and verifier data in the targets of a recursion
    circuit."""
    inner_proof, inner_verifier_only, _ = inner
    pw = PartialWitness()
    set_proof_with_pis_target(pw, pt, inner_proof)
    set_verifier_data_target(pw, vdt, inner_verifier_only)
    return pw


def recursive_proof(inner, config: CircuitConfig, min_degree_bits=None, device=None) -> Layer:
    """One recursion layer over `inner` = (proof, verifier-only data, common
    data), built and proved on `device` (CUDA unless the caller asks for
    another) and verified."""
    device = resolve_device(device)
    t = time.perf_counter()
    data, pt, vdt = recursion_circuit(inner[2], config, min_degree_bits, device)
    return _prove_layer(data, time.perf_counter() - t, recursion_inputs(pt, vdt, inner), device)


def chain(size: int, config: CircuitConfig | None = None, device=None,
          lookup_type: int = 0) -> list[Layer]:
    """The inner proof at 2^size (of the noop circuit, or of the lookup
    circuit of `lookup_type` 1 or 2), the middle proof over it and the
    outer proof over that, every layer under `config` (the standard
    recursion config unless given; `CircuitConfig.standard_recursion_zk_config()`
    blinds and salts all three), on `device` (CUDA unless the caller asks
    for another), each verified; inner first (the reference package's
    examples/bench_recursion.py `run_chain`)."""
    device = resolve_device(device)
    config = config or CircuitConfig.standard_recursion_config()
    layers = [dummy_lookup_proof(config, size, device, lookup_type) if lookup_type
              else dummy_proof(config, size, device)]
    for _ in ("middle", "outer"):
        layers.append(recursive_proof(layers[-1].inner, config, device=device))
    return layers


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=14, help="log2 of the inner degree")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    p.add_argument("--lookup-type", type=int, default=0, choices=(0, 1, 2),
                   help="the inner circuit: 0 noops, 1 one TIP5 lookup, 2 515 lookups")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    layers = chain(args.size, device=args.device, lookup_type=args.lookup_type)
    for name, layer in zip(("inner", "middle", "outer"), layers):
        print(f"{name}: degree 2^{layer.data.common.degree_bits}, build "
              f"{layer.build_s:.3f} s, prove {layer.prove_s:.3f} s")
    print(f"bench_recursion chain built, proved and verified in "
          f"{time.perf_counter() - t0:.2f} s")


if __name__ == "__main__":
    main()
