"""Byte-exact proof serialization both ways (reference
util/serialization/mod.rs), on the FRI proof writer and reader of
`fri/serialization.py`: the three caps, the opening set (with the empty
lookup openings in their place), the FRI proof, then the public inputs with
their count. `proof_from_bytes` reads a proof of a circuit without lookups
or zero knowledge, its shapes from the common data (reference
plonk/serialization.py:358)."""

from __future__ import annotations

from plonky2_torch.fri.serialization import Reader as FriReader
from plonky2_torch.fri.serialization import Writer as FriWriter
from plonky2_torch.plonk.proof import OpeningSet, Proof, ProofWithPublicInputs


class Writer(FriWriter):
    def write_opening_set(self, os: OpeningSet) -> None:
        self.write_field_ext_vec(os.constants)
        self.write_field_ext_vec(os.plonk_sigmas)
        self.write_field_ext_vec(os.wires)
        self.write_field_ext_vec(os.plonk_zs)
        self.write_field_ext_vec(os.plonk_zs_next)
        # lookup_zs and lookup_zs_next: empty (lookups are not ported)
        self.write_field_ext_vec(os.partial_products)
        self.write_field_ext_vec(os.quotient_polys)

    def write_proof(self, proof: Proof) -> None:
        self.write_merkle_cap(proof.wires_cap)
        self.write_merkle_cap(proof.plonk_zs_partial_products_cap)
        self.write_merkle_cap(proof.quotient_polys_cap)
        self.write_opening_set(proof.openings)
        self.write_fri_proof(proof.opening_proof)

    def write_proof_with_public_inputs(self, pwp: ProofWithPublicInputs) -> None:
        self.write_proof(pwp.proof)
        self.write_usize(len(pwp.public_inputs))
        self.write_field_vec(pwp.public_inputs)


def proof_to_bytes(pwp: ProofWithPublicInputs) -> bytes:
    w = Writer()
    w.write_proof_with_public_inputs(pwp)
    return bytes(w.buf)


class Reader(FriReader):
    def read_opening_set(self, common) -> OpeningSet:
        config = common.config
        nc = config.num_challenges
        ext = self.read_field_ext_vec
        return OpeningSet(
            constants=ext(common.num_constants),
            plonk_sigmas=ext(config.num_routed_wires),
            wires=ext(config.num_wires),
            plonk_zs=ext(nc),
            plonk_zs_next=ext(nc),
            partial_products=ext(nc * common.num_partial_products),
            quotient_polys=ext(common.num_quotient_polys()))

    def read_proof(self, common) -> Proof:
        if common.num_lookup_polys or common.fri_params.hiding:
            raise ValueError("proofs with lookups or zero knowledge are not ported")
        cap_height = common.config.fri_config.cap_height
        caps = [self.read_merkle_cap(cap_height) for _ in range(3)]
        openings = self.read_opening_set(common)
        num_leaves_per_oracle = [common.num_preprocessed_polys(), common.config.num_wires,
                                 common.num_zs_partial_products_polys(),
                                 common.num_quotient_polys()]
        return Proof(wires_cap=caps[0], plonk_zs_partial_products_cap=caps[1],
                     quotient_polys_cap=caps[2], openings=openings,
                     opening_proof=self.read_fri_proof(num_leaves_per_oracle,
                                                       common.fri_params))

    def read_proof_with_public_inputs(self, common) -> ProofWithPublicInputs:
        proof = self.read_proof(common)
        return ProofWithPublicInputs(proof=proof,
                                     public_inputs=self.read_field_vec(self.read_usize()))


def proof_from_bytes(data: bytes, common) -> ProofWithPublicInputs:
    r = Reader(data)
    pwp = r.read_proof_with_public_inputs(common)
    if r.pos != len(data):
        raise ValueError(f"{len(data) - r.pos} trailing bytes")
    return pwp
