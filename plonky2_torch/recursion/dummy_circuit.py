"""Dummy circuits and their proofs (reference recursion/dummy_circuit.rs;
the reference package's recursion/dummy_circuit.py).

A dummy circuit has exactly a given `CommonCircuitData`: noop rows, the
common data's gates and its number of public inputs. Its proof stands in
for a proof that a conditional or cyclic verifier skips. The circuit is
built and proved on the caller's device (CUDA unless the caller asks for
another). `DummyProofGenerator` writes a dummy proof and its verifier
data into the targets of a circuit being built; it has no opcode in the
native witness plan, so both witness engines run its `run_batch`: one
vector write of every target.
"""

from __future__ import annotations

import numpy as np

from plonky2_torch.gates.simple_gates import NoopGate
from plonky2_torch.iop.generator import SimpleGenerator
from plonky2_torch.iop.target import target_index
from plonky2_torch.iop.witness import PartialWitness
from plonky2_torch.recursion.recursive_verifier import (
    add_virtual_proof_with_pis,
    add_virtual_verifier_data,
    set_proof_with_pis_target,
    set_verifier_data_target,
)
from plonky2_torch.util import TimingTree


def dummy_circuit(common_data, device=None):
    """A circuit whose common data is `common_data`, built on `device`
    (reference dummy_circuit.rs:92-120)."""
    from plonky2_torch.plonk.circuit_builder import CircuitBuilder

    if common_data.config.zero_knowledge:
        raise ValueError("the degree of a zero-knowledge dummy circuit can be off")
    num_noop = common_data.degree - -(-common_data.num_public_inputs // 8) - 2
    builder = CircuitBuilder(common_data.config)
    for _ in range(num_noop):
        builder.add_gate(NoopGate(), [])
    for gate in common_data.gates:
        builder.gates.setdefault(gate.id(), gate)
    for _ in range(common_data.num_public_inputs):
        builder.register_public_input(builder.add_virtual_target())
    circuit = builder.build(device=device)
    if circuit.common != common_data:
        raise ValueError("the dummy circuit's common data is not the one asked for")
    return circuit


def dummy_proof(circuit, nonzero_public_inputs: dict[int, int] | None = None, device=None):
    """A proof of the dummy `circuit` on `device`, its public inputs zero but
    for `nonzero_public_inputs` (reference dummy_circuit.rs:75-90)."""
    nonzero_public_inputs = nonzero_public_inputs or {}
    pw = PartialWitness()
    for i in range(circuit.common.num_public_inputs):
        pw.set_target(circuit.prover_only.public_inputs[i], nonzero_public_inputs.get(i, 0))
    return circuit.prove(pw, device=device)


def cyclic_base_proof(common_data, verifier_data, nonzero_public_inputs=None, device=None):
    """The base proof of a cycle: a dummy proof whose last public inputs are
    `verifier_data`'s digest and cap (reference dummy_circuit.rs:41-71)."""
    nonzero_public_inputs = dict(nonzero_public_inputs or {})
    cap_elements = 1 << common_data.config.fri_config.cap_height
    start_vk_pis = common_data.num_public_inputs - 4 - 4 * cap_elements
    for j, v in enumerate(verifier_data.circuit_digest):
        nonzero_public_inputs[start_vk_pis + j] = v
    for i in range(cap_elements):
        for j, v in enumerate(verifier_data.constants_sigmas_cap[i]):
            nonzero_public_inputs[start_vk_pis + 4 + 4 * i + j] = v
    return dummy_proof(dummy_circuit(common_data, device), nonzero_public_inputs, device)


class _BufferWriter:
    """A PartialWitness-like facade over a GeneratedValues buffer."""

    def __init__(self, out):
        self.out = out

    def set_target(self, t, v):
        self.out.set_target(t, v)

    def set_targets(self, ts, vs):
        for t, v in zip(ts, vs):
            self.set_target(t, v)

    def set_extension_target(self, et, v):
        self.set_targets(et.parts, v)

    def set_hash_target(self, ht, v):
        self.set_targets(ht, v)


class _TargetRecorder(_BufferWriter):
    """Records the targets and values written, in order."""

    def __init__(self):
        self.targets: list = []
        self.values: list[int] = []

    def set_target(self, t, v):
        self.targets.append(t)
        self.values.append(int(v))


class DummyProofGenerator(SimpleGenerator):
    """Writes a dummy proof and its verifier data into their targets; no
    dependencies (reference dummy_circuit.rs:160-293)."""

    BATCH_MIN = 1  # one vector write even for one generator

    def __init__(self, proof_with_pis_target, proof_with_pis, verifier_data_target,
                 verifier_only, inner_common=None):
        self.proof_with_pis_target = proof_with_pis_target
        self.proof_with_pis = proof_with_pis
        self.verifier_data_target = verifier_data_target
        self.verifier_only = verifier_only
        self.inner_common = inner_common  # the dummy circuit's common data
        self._written = None
        self._index = None  # the written targets' flat indices

    def _write(self, pw) -> None:
        set_proof_with_pis_target(pw, self.proof_with_pis_target, self.proof_with_pis)
        set_verifier_data_target(pw, self.verifier_data_target, self.verifier_only)

    def _recorded(self) -> _TargetRecorder:
        if self._written is None:
            self._written = _TargetRecorder()
            self._write(self._written)
        return self._written

    def dependencies(self):
        return []

    def outputs(self):
        return list(self._recorded().targets)

    def run_once(self, witness, out_buffer):
        self._write(_BufferWriter(out_buffer))

    @classmethod
    def run_batch(cls, gens, witness):
        for g in gens:
            rec = g._recorded()
            if g._index is None:
                g._index = np.fromiter((target_index(t, witness.num_wires, witness.degree)
                                        for t in rec.targets), np.int64, len(rec.targets))
            witness.set_reps(witness.rep_map[g._index], np.asarray(rec.values, dtype=np.uint64))


def dummy_proof_and_vk(builder, common_data, device=None, timing: TimingTree | None = None):
    """(proof targets, verifier-data targets) that a DummyProofGenerator
    fills with a proof of a dummy circuit of `common_data`, built and proved
    on `device` (reference dummy_circuit.rs:121-143). `timing` gets the
    scopes "dummy circuit build" and "dummy prove"."""
    timing = timing or TimingTree("dummy")
    with timing.scope("dummy circuit build"):
        circuit = dummy_circuit(common_data, device)
    with timing.scope("dummy prove"):
        proof = dummy_proof(circuit, device=device)
    proof_t = add_virtual_proof_with_pis(builder, common_data)
    vk_t = add_virtual_verifier_data(builder, builder.config.fri_config.cap_height)
    builder.add_simple_generator(DummyProofGenerator(proof_t, proof, vk_t, circuit.verifier_only,
                                                     inner_common=circuit.common))
    return proof_t, vk_t
