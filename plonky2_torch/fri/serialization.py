"""Byte-exact proof serialization, up to the FRI proof (all integers
little-endian): field element = canonical u64; extension element = its D
coordinates; digest = 4 field elements; Merkle cap = its digests with no
length prefix; Merkle proof = u8 sibling count then digests; FRI proof =
commit-phase caps, query rounds, final polynomial, PoW witness."""

from __future__ import annotations

import struct

from plonky2_torch.fri.proof import FriProof
from plonky2_torch.hash.merkle import MerkleProof


class Writer:
    def __init__(self):
        self.buf = bytearray()

    def write_u8(self, x: int) -> None:
        self.buf.append(x)

    def write_usize(self, x: int) -> None:
        self.buf += struct.pack("<Q", x)

    def write_field(self, x: int) -> None:
        self.buf += struct.pack("<Q", x)

    def write_field_vec(self, v) -> None:
        for x in v:
            self.write_field(x)

    def write_field_ext(self, x) -> None:
        for c in x:
            self.write_field(c)

    def write_field_ext_vec(self, v) -> None:
        for x in v:
            self.write_field_ext(x)

    def write_hash(self, h) -> None:
        self.write_field_vec(h)

    def write_merkle_cap(self, cap) -> None:
        for h in cap:
            self.write_hash(h)

    def write_merkle_proof(self, p: MerkleProof) -> None:
        self.write_u8(len(p.siblings))
        for h in p.siblings:
            self.write_hash(h)

    def write_fri_proof(self, fp: FriProof) -> None:
        for cap in fp.commit_phase_merkle_caps:
            self.write_merkle_cap(cap)
        for fqr in fp.query_round_proofs:
            for v, p in fqr.initial_trees_proof.evals_proofs:
                self.write_field_vec(v)
                self.write_merkle_proof(p)
            for fqs in fqr.steps:
                self.write_field_ext_vec(fqs.evals)
                self.write_merkle_proof(fqs.merkle_proof)
        self.write_field_ext_vec(fp.final_poly)
        self.write_field(fp.pow_witness)
