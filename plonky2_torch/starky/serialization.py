"""STARK proof bytes both ways, in the layout of the reference package's
starky/serialization.py (the reference's buffer serde pattern,
starky/src/proof.rs:75-118, with explicit lengths so that a proof reads
without its Stark): degree_bits, the trace cap, the optional auxiliary and
quotient caps, the openings as length-prefixed extension vectors, the FRI
proof, then the public inputs with their count. Caps are sized by the
config's cap_height and the FRI proof by the derived FriParams."""

from __future__ import annotations

from plonky2_torch.plonk.serialization import Reader, Writer
from plonky2_torch.starky.proof import StarkOpeningSet, StarkProof, StarkProofWithPublicInputs


class StarkWriter(Writer):
    def write_bool(self, b: bool) -> None:
        self.write_u8(1 if b else 0)

    def write_opt_cap(self, cap) -> None:
        self.write_bool(cap is not None)
        if cap is not None:
            self.write_merkle_cap(cap)

    def write_opt_ext_vec(self, v) -> None:
        self.write_bool(v is not None)
        if v is not None:
            self.write_usize(len(v))
            self.write_field_ext_vec(v)

    def write_stark_proof(self, proof: StarkProof, config) -> None:
        self.write_usize(proof.recover_degree_bits(config))
        self.write_merkle_cap(proof.trace_cap)
        self.write_opt_cap(proof.auxiliary_polys_cap)
        self.write_opt_cap(proof.quotient_polys_cap)
        os = proof.openings
        self.write_usize(len(os.local_values))
        self.write_field_ext_vec(os.local_values)
        self.write_field_ext_vec(os.next_values)
        self.write_opt_ext_vec(os.auxiliary_polys)
        self.write_opt_ext_vec(os.auxiliary_polys_next)
        self.write_bool(os.ctl_zs_first is not None)
        if os.ctl_zs_first is not None:
            self.write_usize(len(os.ctl_zs_first))
            self.write_field_vec(os.ctl_zs_first)
        self.write_opt_ext_vec(os.quotient_polys)
        self.write_fri_proof(proof.opening_proof)


class StarkReader(Reader):
    def read_bool(self) -> bool:
        return self.read_u8() != 0

    def read_opt_cap(self, cap_height: int):
        if self.read_bool():
            return self.read_merkle_cap(cap_height)
        return None

    def read_opt_ext_vec(self):
        if self.read_bool():
            return self.read_field_ext_vec(self.read_usize())
        return None

    def read_stark_proof(self, config) -> StarkProof:
        cap_height = config.fri_config.cap_height
        degree_bits = self.read_usize()
        trace_cap = self.read_merkle_cap(cap_height)
        aux_cap = self.read_opt_cap(cap_height)
        quot_cap = self.read_opt_cap(cap_height)
        local_values = self.read_field_ext_vec(self.read_usize())
        next_values = self.read_field_ext_vec(len(local_values))
        aux = self.read_opt_ext_vec()
        aux_next = self.read_opt_ext_vec()
        ctl_zs_first = (self.read_field_vec(self.read_usize())
                        if self.read_bool() else None)
        quotient = self.read_opt_ext_vec()
        openings = StarkOpeningSet(
            local_values=local_values, next_values=next_values,
            auxiliary_polys=aux, auxiliary_polys_next=aux_next,
            ctl_zs_first=ctl_zs_first, quotient_polys=quotient,
        )
        num_leaves = [len(local_values)]
        if aux is not None:
            num_leaves.append(len(aux))
        if quotient is not None:
            num_leaves.append(len(quotient))
        opening_proof = self.read_fri_proof(num_leaves, config.fri_params(degree_bits))
        return StarkProof(
            trace_cap=trace_cap, auxiliary_polys_cap=aux_cap,
            quotient_polys_cap=quot_cap, openings=openings,
            opening_proof=opening_proof,
        )


def stark_proof_to_bytes(pwp: StarkProofWithPublicInputs, config) -> bytes:
    w = StarkWriter()
    w.write_stark_proof(pwp.proof, config)
    w.write_usize(len(pwp.public_inputs))
    w.write_field_vec(pwp.public_inputs)
    return bytes(w.buf)


def stark_proof_from_bytes(data: bytes, config) -> StarkProofWithPublicInputs:
    r = StarkReader(data)
    proof = r.read_stark_proof(config)
    public_inputs = r.read_field_vec(r.read_usize())
    if r.pos != len(data):
        raise ValueError(f"{len(data) - r.pos} trailing bytes")
    return StarkProofWithPublicInputs(proof=proof, public_inputs=public_inputs)
