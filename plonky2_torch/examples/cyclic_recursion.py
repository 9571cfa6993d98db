"""The IVC hash chain: a circuit that verifies a proof of itself (reference
plonky2/src/recursion/cyclic_recursion.rs's test; the reference package's
tests/validation_cyclic.py).

    python -m plonky2_torch.examples.cyclic_recursion --layers 2   # on the card

Each proof of the chain applies Poseidon's `hash_no_pad` once more to a
hash chain. Its public inputs are the initial hash (4), the chain tip (4),
the counter of hashes applied (1), then the circuit's own verification
key (the digest and the 16 cap entries). The base case verifies a dummy
proof; every later layer verifies the proof before it. The circuit's
common data is the fixpoint of recursion: the common data of a circuit
that verifies a proof of a circuit that verifies a proof of the empty
circuit (degree 2^13, the gates of the bench_recursion middle circuit).
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

from plonky2_torch import resolve_device
from plonky2_torch.gates.simple_gates import NoopGate
from plonky2_torch.hash.poseidon import hash_no_pad
from plonky2_torch.iop.witness import PartialWitness
from plonky2_torch.plonk.circuit_builder import CircuitBuilder
from plonky2_torch.plonk.config import CircuitConfig
from plonky2_torch.recursion.cyclic_recursion import (
    add_verifier_data_public_inputs,
    check_cyclic_proof_verifier_data,
    conditionally_verify_cyclic_proof_or_dummy,
)
from plonky2_torch.recursion.dummy_circuit import cyclic_base_proof
from plonky2_torch.recursion.recursive_verifier import (
    add_virtual_proof_with_pis,
    add_virtual_verifier_data,
    set_proof_with_pis_target,
    set_verifier_data_target,
    verify_proof,
)
from plonky2_torch.util import TimingTree

INITIAL = [0, 1, 2, 3]  # the chain's initial hash
COUNTER = 8  # the counter's public input; the tip is 4..8


def common_data_for_recursion(device=None, timing: TimingTree | None = None):
    """The fixpoint's circuit (CircuitData), built on `device`: the empty
    circuit, a circuit verifying its proof, and one verifying that, padded
    to at least 2^12 rows (reference validation_cyclic.py:38-53, which
    returns the last circuit's common data). `timing` gets one scope a
    circuit: "empty circuit", "level 1" and "level 2"."""
    timing = timing or TimingTree("fixpoint")
    config = CircuitConfig.standard_recursion_config()
    with timing.scope("empty circuit"):
        data = CircuitBuilder(config).build(device=device)
    for level in range(2):
        with timing.scope(f"level {level + 1}"):
            builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
            pt = add_virtual_proof_with_pis(builder, data.common)
            vdt = add_virtual_verifier_data(builder, config.fri_config.cap_height)
            verify_proof(builder, pt, vdt, data.common)
            if level == 1:
                while builder.num_gates() < (1 << 12):
                    builder.add_gate(NoopGate(), [])
            data = builder.build(device=device)
    return data


class CyclicCircuit(NamedTuple):
    """The built hash-chain circuit and the targets a prove fills."""
    data: object  # CircuitData
    condition: object  # BoolTarget: verify the inner proof (else the dummy)
    inner: object  # ProofWithPublicInputsTarget
    verifier_data: object  # VerifierCircuitTarget of the public inputs


def cyclic_circuit(common_data, device=None, timing: TimingTree | None = None) -> CyclicCircuit:
    """The hash-chain circuit over the fixpoint `common_data` (whose
    `num_public_inputs` it sets to the chain's), built on `device`
    (reference validation_cyclic.py:56-87). `timing` gets the scopes "hash
    chain", "dummy circuit build", "dummy prove", "in-circuit verifier" and
    the build's."""
    timing = timing or TimingTree("build")
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
    with timing.scope("hash chain"):
        one = builder.one()
        initial_hash = builder.add_virtual_hash()
        builder.register_public_inputs(initial_hash)
        current_hash_in = builder.add_virtual_hash()
        current_hash_out = builder.hash_n_to_hash_no_pad(list(current_hash_in))
        builder.register_public_inputs(current_hash_out)
        counter = builder.add_virtual_public_input()
        verifier_data = add_verifier_data_public_inputs(builder)
        common_data.num_public_inputs = builder.num_public_inputs()

        condition = builder.add_virtual_bool_target_safe()
        inner = add_virtual_proof_with_pis(builder, common_data)
        inner_pis = inner.public_inputs
        builder.connect_hashes(initial_hash, inner_pis[0:4])
        actual_hash_in = builder.select_hash(condition, inner_pis[4:8], initial_hash)
        builder.connect_hashes(current_hash_in, actual_hash_in)
        builder.connect(counter, builder.mul_add(condition.target, inner_pis[COUNTER], one))
    conditionally_verify_cyclic_proof_or_dummy(builder, condition, inner, common_data, device,
                                               timing)
    data = builder.build(device=device, timing=timing)
    return CyclicCircuit(data, condition, inner, verifier_data)


def _inputs(circuit: CyclicCircuit, condition: bool, inner_proof) -> PartialWitness:
    pw = PartialWitness()
    pw.set_bool_target(circuit.condition, condition)
    set_proof_with_pis_target(pw, circuit.inner, inner_proof)
    set_verifier_data_target(pw, circuit.verifier_data, circuit.data.verifier_only)
    return pw


def base_proof(circuit: CyclicCircuit, initial=INITIAL, device=None, timing=None):
    """The chain's first proof (counter 1), on `device`: the condition
    false, and in the inner proof's targets `cyclic_base_proof` (a dummy
    proof, built and proved on `device`, carrying `initial` and the
    circuit's verification key)."""
    data = circuit.data
    base = cyclic_base_proof(data.common, data.verifier_only, dict(enumerate(initial)), device)
    return data.prove(_inputs(circuit, False, base), device=device, timing=timing)


def step(circuit: CyclicCircuit, proof, device=None, timing=None):
    """The proof after `proof` (one hash more), on `device`: the condition
    true and `proof` in the inner proof's targets."""
    return circuit.data.prove(_inputs(circuit, True, proof), device=device, timing=timing)


def check(circuit: CyclicCircuit, proof, counter: int, initial=INITIAL) -> None:
    """Raises ValueError unless `proof` carries the circuit's verification
    key, passes the verifier, has `counter` and has the tip of `counter`
    host `hash_no_pad`s of `initial`."""
    data = circuit.data
    check_cyclic_proof_verifier_data(proof, data.verifier_only, data.common)
    data.verify(proof)
    tip = list(initial)
    for _ in range(counter):
        tip = hash_no_pad(tip)
    pis = [int(v) for v in proof.public_inputs]
    if pis[COUNTER] != counter or pis[4:8] != tip:
        raise ValueError(f"the chain's counter {pis[COUNTER]} and tip {pis[4:8]} are not "
                         f"{counter} and {tip}")


class Chain(NamedTuple):
    """The circuit, its build times (the fixpoint's and its own, seconds)
    and the proofs, base first, with each prove's seconds."""
    circuit: CyclicCircuit
    fixpoint_s: float
    build_s: float
    proofs: list
    prove_s: list


def chain(layers: int = 2, device=None) -> Chain:
    """The fixpoint and the hash-chain circuit built, the base proof and
    `layers` self-verifying layers proved on `device` (CUDA unless the
    caller asks for another), each checked (`check`)."""
    device = resolve_device(device)
    t = time.perf_counter()
    common_data = common_data_for_recursion(device).common
    fixpoint_s = time.perf_counter() - t
    t = time.perf_counter()
    circuit = cyclic_circuit(common_data, device)
    build_s = time.perf_counter() - t
    proofs, prove_s = [], []
    for layer in range(layers + 1):
        t = time.perf_counter()
        proof = (base_proof(circuit, device=device) if layer == 0 else
                 step(circuit, proofs[-1], device=device))
        prove_s.append(time.perf_counter() - t)
        check(circuit, proof, layer + 1)
        proofs.append(proof)
    return Chain(circuit, fixpoint_s, build_s, proofs, prove_s)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--layers", type=int, default=2, help="self-verifying layers after the base")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)
    out = chain(args.layers, args.device)
    print(f"fixpoint built in {out.fixpoint_s:.3f} s; cyclic circuit (degree "
          f"2^{out.circuit.data.common.degree_bits}) built in {out.build_s:.3f} s")
    for layer, s in enumerate(out.prove_s):
        print(f"{'base' if layer == 0 else f'layer {layer}'}: counter {layer + 1}, proved in "
              f"{s:.3f} s, checked")


if __name__ == "__main__":
    main()
