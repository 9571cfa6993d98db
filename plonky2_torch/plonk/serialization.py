"""Byte-exact proof serialization both ways (reference
util/serialization/mod.rs), on the FRI proof writer and reader of
`fri/serialization.py`: the three caps, the opening set (the lookup
columns' openings at ζ and g·ζ after the Zs'), the FRI proof, then the
public inputs with their count. `proof_from_bytes` reads a proof, its
shapes from the common data (the Zs-partial-products leaves with the
lookup columns) and its digests' form from the common data's generic
config (reference plonk/serialization.py:358).

A compressed proof (`plonk/compressed.py`; reference mod.rs:1042-1160,
2032-2126) has the caps and openings, then the FRI proof's caps, the query
indices as u32s in query order, each distinct index's initial openings in
ascending order, per fold step each distinct coset's values less the one
the verifier infers, the final polynomial and the PoW witness; the public
inputs follow with no count."""

from __future__ import annotations

import struct

from plonky2_torch.fri.proof import SALT_SIZE, FriInitialTreeProof, FriQueryStep
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
        self.write_field_ext_vec(os.lookup_zs)
        self.write_field_ext_vec(os.lookup_zs_next)
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


    # -- compressed proofs ---------------------------------------------------

    def write_u32(self, x: int) -> None:
        self.buf += struct.pack("<I", x)

    def write_compressed_fri_proof(self, cfp, params) -> None:
        for cap in cfp.commit_phase_merkle_caps:
            self.write_merkle_cap(cap)
        rounds = cfp.query_round_proofs
        for i in rounds.indices:
            self.write_u32(i)
        indices = sorted(set(rounds.indices))
        for i in indices:
            for v, p in rounds.initial_trees_proofs[i].evals_proofs:
                self.write_field_vec(v)
                self.write_merkle_proof(p)
        for arity_bits, steps in zip(params.reduction_arity_bits, rounds.steps):
            indices = sorted({i >> arity_bits for i in indices})
            for i in indices:
                self.write_field_ext_vec(steps[i].evals)
                self.write_merkle_proof(steps[i].merkle_proof)
        self.write_field_ext_vec(cfp.final_poly)
        self.write_field(cfp.pow_witness)

    def write_compressed_proof_with_public_inputs(self, cpwp, params) -> None:
        proof = cpwp.proof
        self.write_merkle_cap(proof.wires_cap)
        self.write_merkle_cap(proof.plonk_zs_partial_products_cap)
        self.write_merkle_cap(proof.quotient_polys_cap)
        self.write_opening_set(proof.openings)
        self.write_compressed_fri_proof(proof.opening_proof, params)
        self.write_field_vec(cpwp.public_inputs)


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
            lookup_zs=ext(common.num_all_lookup_polys()),
            lookup_zs_next=ext(common.num_all_lookup_polys()),
            partial_products=ext(nc * common.num_partial_products),
            quotient_polys=ext(common.num_quotient_polys()))

    def _read_caps_and_openings(self, common):
        """The three caps, the opening set and the initial trees' leaf
        widths, each salted oracle's with its SALT_SIZE salt (reference
        plonk/serialization.py:249-254)."""
        cap_height = common.config.fri_config.cap_height
        caps = [self.read_merkle_cap(cap_height) for _ in range(3)]
        openings = self.read_opening_set(common)
        salt = SALT_SIZE if common.fri_params.hiding else 0
        num_leaves_per_oracle = [common.num_preprocessed_polys(),
                                 common.config.num_wires + salt,
                                 common.num_zs_partial_products_polys()
                                 + common.num_all_lookup_polys() + salt,
                                 common.num_quotient_polys() + salt]
        return caps, openings, num_leaves_per_oracle

    def read_proof(self, common) -> Proof:
        caps, openings, num_leaves_per_oracle = self._read_caps_and_openings(common)
        return Proof(wires_cap=caps[0], plonk_zs_partial_products_cap=caps[1],
                     quotient_polys_cap=caps[2], openings=openings,
                     opening_proof=self.read_fri_proof(num_leaves_per_oracle,
                                                       common.fri_params))

    def read_u32(self) -> int:
        (x,) = struct.unpack_from("<I", self.data, self.pos)
        self.pos += 4
        return x

    def read_compressed_fri_proof(self, num_leaves_per_oracle, params):
        from plonky2_torch.plonk.compressed import CompressedFriProof, CompressedFriQueryRounds

        caps = [self.read_merkle_cap(params.config.cap_height)
                for _ in params.reduction_arity_bits]
        original = [self.read_u32() for _ in range(params.config.num_query_rounds)]
        indices = sorted(set(original))
        initial = {i: FriInitialTreeProof(evals_proofs=[
            (self.read_field_vec(n), self.read_merkle_proof()) for n in num_leaves_per_oracle])
            for i in indices}
        steps = []
        for arity_bits in params.reduction_arity_bits:
            indices = sorted({i >> arity_bits for i in indices})
            steps.append({i: FriQueryStep(evals=self.read_field_ext_vec((1 << arity_bits) - 1),
                                          merkle_proof=self.read_merkle_proof())
                          for i in indices})
        final_poly = self.read_field_ext_vec(params.final_poly_len())
        return CompressedFriProof(
            commit_phase_merkle_caps=caps,
            query_round_proofs=CompressedFriQueryRounds(indices=original,
                                                        initial_trees_proofs=initial,
                                                        steps=steps),
            final_poly=final_poly, pow_witness=self.read_field())

    def read_compressed_proof_with_public_inputs(self, common):
        from plonky2_torch.plonk.compressed import (
            CompressedProof,
            CompressedProofWithPublicInputs,
        )

        caps, openings, num_leaves_per_oracle = self._read_caps_and_openings(common)
        proof = CompressedProof(
            wires_cap=caps[0], plonk_zs_partial_products_cap=caps[1], quotient_polys_cap=caps[2],
            openings=openings,
            opening_proof=self.read_compressed_fri_proof(num_leaves_per_oracle,
                                                         common.fri_params))
        public_inputs = self.read_field_vec((len(self.data) - self.pos) // 8)
        return CompressedProofWithPublicInputs(proof=proof, public_inputs=public_inputs)

    def read_proof_with_public_inputs(self, common) -> ProofWithPublicInputs:
        proof = self.read_proof(common)
        return ProofWithPublicInputs(proof=proof,
                                     public_inputs=self.read_field_vec(self.read_usize()))


def proof_from_bytes(data: bytes, common) -> ProofWithPublicInputs:
    r = Reader(data, common.generic_config().hasher)
    pwp = r.read_proof_with_public_inputs(common)
    if r.pos != len(data):
        raise ValueError(f"{len(data) - r.pos} trailing bytes")
    return pwp


def compressed_proof_to_bytes(cpwp, common) -> bytes:
    w = Writer()
    w.write_compressed_proof_with_public_inputs(cpwp, common.fri_params)
    return bytes(w.buf)


def compressed_proof_from_bytes(data: bytes, common):
    r = Reader(data, common.generic_config().hasher)
    cpwp = r.read_compressed_proof_with_public_inputs(common)
    if r.pos != len(data):
        raise ValueError(f"{len(data) - r.pos} trailing bytes")
    return cpwp
