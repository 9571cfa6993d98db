"""Verifier circuit data to and from the reference's bytes (reference
util/serialization/mod.rs:1623-1960; the reference package's
plonk/circuit_serialization.py:56-362): the verifier-only data (cap
height, constants-sigmas cap, circuit digest), then the common data. The
reader is the common-data reader of `prover_serialization.py`; the writer
writes each gate with its tag in the reference's registry order
(`prover_serialization.GATE_TAGS`) and its parameters.
`bench_cache/inner14.verifier.bin` and `fixtures/*.verifier.bin` are in
this layout."""

from __future__ import annotations

import struct

from plonky2_torch.fri.serialization import Writer
from plonky2_torch.gates.arithmetic_base import ArithmeticGate
from plonky2_torch.gates.arithmetic_extension import ArithmeticExtensionGate, MulExtensionGate
from plonky2_torch.gates.base_sum import BaseSumGate
from plonky2_torch.gates.coset_interpolation import CosetInterpolationGate
from plonky2_torch.gates.random_access import RandomAccessGate
from plonky2_torch.gates.reducing import ReducingExtensionGate, ReducingGate
from plonky2_torch.gates.simple_gates import ConstantGate
from plonky2_torch.plonk.circuit_data import CommonCircuitData, VerifierOnlyCircuitData
from plonky2_torch.plonk.prover_serialization import GATE_TAGS, Reader

_TAG_OF = {name: tag for tag, (name, _) in enumerate(GATE_TAGS)}


class CircuitWriter(Writer):
    def write_bool(self, b: bool) -> None:
        self.write_u8(1 if b else 0)

    def write_u32(self, x: int) -> None:
        self.buf += struct.pack("<I", x)

    def write_usize_vec(self, v) -> None:
        self.write_usize(len(v))
        for x in v:
            self.write_usize(x)

    def write_fri_reduction_strategy(self, rs) -> None:
        if rs.kind == "fixed":
            self.write_u8(0)
            self.write_usize_vec(list(rs.fixed))
        elif rs.kind == "constant_arity":
            self.write_u8(1)
            self.write_usize(rs.arity_bits)
            self.write_usize(rs.final_poly_bits)
        else:  # MinSize
            self.write_u8(2)
            self.write_bool(rs.max_arity_bits is not None)
            if rs.max_arity_bits is not None:
                self.write_usize(rs.max_arity_bits)

    def write_fri_config(self, cfg) -> None:
        for x in (cfg.rate_bits, cfg.cap_height, cfg.num_query_rounds):
            self.write_usize(x)
        self.write_u32(cfg.proof_of_work_bits)
        self.write_fri_reduction_strategy(cfg.reduction_strategy)

    def write_fri_params(self, p) -> None:
        self.write_fri_config(p.config)
        self.write_usize_vec(list(p.reduction_arity_bits))
        self.write_usize(p.degree_bits)
        self.write_bool(p.hiding)

    def write_circuit_config(self, c) -> None:
        for x in (c.num_wires, c.num_routed_wires, c.num_constants, c.security_bits,
                  c.num_challenges, c.max_quotient_degree_factor):
            self.write_usize(x)
        self.write_bool(c.use_base_arithmetic_gate)
        self.write_bool(c.zero_knowledge)
        self.write_fri_config(c.fri_config)

    def write_gate(self, gate) -> None:
        name = type(gate).__name__
        if name not in _TAG_OF:
            raise ValueError(f"no registry tag for {gate.id()}")
        self.write_u32(_TAG_OF[name])
        if isinstance(gate, (ArithmeticGate, ArithmeticExtensionGate, MulExtensionGate)):
            self.write_usize(gate.num_ops)
        elif isinstance(gate, BaseSumGate):
            if gate.base != 2:
                raise ValueError("the registry's BaseSumGate tag is BaseSumGate<2>")
            self.write_usize(gate.num_limbs)
        elif isinstance(gate, ConstantGate):
            self.write_usize(gate.num_consts)
        elif isinstance(gate, CosetInterpolationGate):
            self.write_usize(gate.subgroup_bits)
            self.write_usize(gate.degree())
            self.write_usize(len(gate.barycentric_weights))
            self.write_field_vec(gate.barycentric_weights)
        elif isinstance(gate, RandomAccessGate):
            for x in (gate.bits, gate.num_copies, gate.num_extra_constants):
                self.write_usize(x)
        elif isinstance(gate, (ReducingGate, ReducingExtensionGate)):
            self.write_usize(gate.num_coeffs)
        # Noop, Poseidon, PublicInput: no payload

    def write_common_circuit_data(self, common: CommonCircuitData) -> None:
        self.write_circuit_config(common.config)
        self.write_fri_params(common.fri_params)
        si = common.selectors_info
        self.write_usize_vec(si.selector_indices)
        self.write_usize(len(si.groups))
        for gr in si.groups:
            self.write_usize(gr.start)
            self.write_usize(gr.stop)
        for x in (common.quotient_degree_factor, common.num_gate_constraints,
                  common.num_constants, common.num_public_inputs, len(common.k_is)):
            self.write_usize(x)
        self.write_field_vec(common.k_is)
        for x in (common.num_partial_products, common.num_lookup_polys,
                  common.num_lookup_selectors):
            self.write_usize(x)
        self.write_usize(0)  # lookup tables (ROADMAP item 9)
        self.write_usize(len(common.gates))
        for gate in common.gates:
            self.write_gate(gate)

    def write_verifier_only_circuit_data(self, vd: VerifierOnlyCircuitData) -> None:
        self.write_usize((len(vd.constants_sigmas_cap) - 1).bit_length())
        self.write_merkle_cap(vd.constants_sigmas_cap)
        self.write_hash(vd.circuit_digest)


def verifier_data_to_bytes(verifier_only: VerifierOnlyCircuitData,
                           common: CommonCircuitData) -> bytes:
    w = CircuitWriter()
    w.write_verifier_only_circuit_data(verifier_only)
    w.write_common_circuit_data(common)
    return bytes(w.buf)


def verifier_data_from_bytes(data: bytes) -> tuple[VerifierOnlyCircuitData, CommonCircuitData]:
    r = Reader(data)
    verifier_only = r.verifier_only_circuit_data()
    common = r.common_circuit_data()
    r.finish()
    return verifier_only, common
