"""Cyclic recursion: a circuit that verifies a proof of itself, its own
verifier data carried in its public inputs (reference
recursion/cyclic_recursion.rs; the reference package's
recursion/cyclic_recursion.py).

The verifier data sits at the tail of the public inputs: the circuit
digest, then the constants-sigmas cap. The common data of the verified
proofs is the cycle's fixpoint; the builder holds it as its goal, and its
build checks that the circuit has it.
"""

from __future__ import annotations

from plonky2_torch.recursion.conditional_recursive_verifier import conditionally_verify_proof
from plonky2_torch.recursion.recursive_verifier import (
    VerifierCircuitTarget,
    add_virtual_verifier_data,
)
from plonky2_torch.util import TimingTree


def verifier_data_from_slice(public_inputs: list, common) -> tuple[list, list]:
    """(circuit digest, constants-sigmas cap) from the tail of the public
    inputs, values or targets (reference cyclic_recursion.rs:20-45)."""
    cap_len = 1 << common.config.fri_config.cap_height
    n = len(public_inputs)
    if n < 4 + 4 * cap_len:
        raise ValueError("Not enough public inputs")
    cap = [[public_inputs[n - 4 * (cap_len - i) + j] for j in range(4)]
           for i in range(cap_len)]
    digest = [public_inputs[n - 4 - 4 * cap_len + j] for j in range(4)]
    return digest, cap


def add_verifier_data_public_inputs(builder) -> VerifierCircuitTarget:
    """The circuit's own verifier data as public inputs, registered last
    (reference circuit_builder.rs:429-444). Once per builder."""
    if builder.verifier_data_public_input is not None:
        raise ValueError("add_verifier_data_public_inputs only needs to be called once")
    vd = add_virtual_verifier_data(builder, builder.config.fri_config.cap_height)
    builder.register_public_inputs(vd.circuit_digest)
    for digest in vd.constants_sigmas_cap:
        builder.register_public_inputs(digest)
    builder.verifier_data_public_input = vd
    return vd


def conditionally_verify_cyclic_proof(builder, condition, cyclic_proof_with_pis,
                                      other_proof_with_pis, other_verifier_data,
                                      common_data) -> None:
    """Verify the cyclic proof against the circuit's own verifier data where
    `condition`, else the other proof (reference cyclic_recursion.rs:103-156)."""
    verifier_data = builder.verifier_data_public_input
    if verifier_data is None:
        raise ValueError("Must call add_verifier_data_public_inputs before cyclic recursion")
    if builder.goal_common_data is None:
        builder.goal_common_data = common_data
    elif builder.goal_common_data != common_data:
        raise ValueError("a second goal common data")

    inner_digest, inner_cap = verifier_data_from_slice(cyclic_proof_with_pis.public_inputs,
                                                       common_data)
    # every proof of the cycle carries the same verifier data
    for a, b in zip(inner_digest, verifier_data.circuit_digest):
        builder.connect(a, b)
    for h_a, h_b in zip(inner_cap, verifier_data.constants_sigmas_cap):
        for a, b in zip(h_a, h_b):
            builder.connect(a, b)

    conditionally_verify_proof(builder, condition, cyclic_proof_with_pis, verifier_data,
                               other_proof_with_pis, other_verifier_data, common_data)

    # every gate of common_data, so that the circuit's gates are the goal's
    for g in common_data.gates:
        builder.gates.setdefault(g.id(), g)


def conditionally_verify_cyclic_proof_or_dummy(builder, condition, cyclic_proof_with_pis,
                                               common_data, device=None,
                                               timing=None) -> None:
    """The cyclic proof where `condition`, else a dummy proof of
    `common_data`'s shape, built and proved on `device` (reference
    cyclic_recursion.rs:158-176). `timing` gets the scopes "dummy circuit
    build", "dummy prove" and "in-circuit verifier"."""
    from plonky2_torch.recursion import dummy_circuit

    timing = timing or TimingTree("cyclic verifier")
    dummy_pt, dummy_vdt = dummy_circuit.dummy_proof_and_vk(builder, common_data, device, timing)
    with timing.scope("in-circuit verifier"):
        conditionally_verify_cyclic_proof(builder, condition, cyclic_proof_with_pis, dummy_pt,
                                          dummy_vdt, common_data)


def check_cyclic_proof_verifier_data(proof_with_pis, verifier_only, common) -> None:
    """Raises unless the verifier data in the proof's public inputs is
    `verifier_only` (reference cyclic_recursion.rs:178-196)."""
    digest, cap = verifier_data_from_slice(proof_with_pis.public_inputs, common)
    if list(digest) != list(verifier_only.circuit_digest):
        raise ValueError("Cyclic proof: circuit digest mismatch")
    for a, b in zip(cap, verifier_only.constants_sigmas_cap):
        if list(a) != list(b):
            raise ValueError("Cyclic proof: constants/sigmas cap mismatch")
