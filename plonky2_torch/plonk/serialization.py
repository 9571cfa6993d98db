"""Byte-exact proof serialization (reference util/serialization/mod.rs), on
the FRI proof writer of `fri/serialization.py`: the three caps, the opening
set (with the empty lookup openings in their place), the FRI proof, then
the public inputs with their count."""

from __future__ import annotations

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
